"""Launchers: the decentralized trainer and its CLI."""
