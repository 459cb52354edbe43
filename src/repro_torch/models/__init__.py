"""Models of the port: the recsys architectures, the dense LM
(attention and the transformer's serving path) and their plumbing."""
