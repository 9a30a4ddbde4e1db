"""The harness's shared parts: the run, the ranks of a cell on several
cards, the traffic generator, the seeded weights, the roofline arithmetic, the trace reduction and the
comparison that decides ``correct``."""
