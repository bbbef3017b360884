"""Entry points and their plumbing (a port of ``repro.launch``): the
serving driver and CLI, the training CLI, the execution policy and the
process groups and meshes."""
