"""Models of the LLM serving path: parameters, layers, MoE, SSM mixers,
the layer stack and the ``Model`` facade (a port of ``repro.models``)."""
