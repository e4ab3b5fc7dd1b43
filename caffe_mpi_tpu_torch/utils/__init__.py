"""Utilities of the port: the MAC model and the card-rate table."""
