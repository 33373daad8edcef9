"""Launchers of the port: ``serve_lamc`` serves a fitted co-clustering model,
``serve`` serves a dense LM (batched prefill, then a decode loop)."""
