"""Models of the port: the recsys architectures and their plumbing."""
