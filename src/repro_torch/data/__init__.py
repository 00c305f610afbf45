"""Synthetic matrices the port is tested and measured on."""
