"""Models of the port: the recsys architectures, the LMs (attention, the
transformer's serving and training paths, the MoE feed-forward), the PNA
GNN and their plumbing."""
