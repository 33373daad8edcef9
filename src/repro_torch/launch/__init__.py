"""Launchers of the port: ``serve_lamc`` serves a fitted model."""
