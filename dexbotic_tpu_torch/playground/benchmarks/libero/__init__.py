"""LIBERO recipes of the ported policies: CogACT, pi0, pi0.5 and DM0."""
