"""SimplerEnv recipes of the ported policies: CogACT, MemVLA and OFT."""
