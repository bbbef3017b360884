"""Entry points: the greedy prefill/decode serving driver and its CLI
(a port of ``repro.launch.driver`` and ``repro.launch.serve``)."""
