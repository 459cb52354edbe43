"""Core of the port: model, index, layouts, scans and the engine registry."""
