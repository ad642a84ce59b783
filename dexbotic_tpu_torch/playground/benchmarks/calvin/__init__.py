"""CALVIN recipes of the ported policies: CogACT and OFT."""
