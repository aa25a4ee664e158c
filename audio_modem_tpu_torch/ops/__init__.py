"""L1 DSP primitives on tensors: bits, constellations, active-bin DFT."""
