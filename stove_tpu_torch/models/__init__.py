"""Models: SuPAIR box encoding, graph-net dynamics, STOVE inference."""
