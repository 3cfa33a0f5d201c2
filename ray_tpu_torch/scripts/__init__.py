"""Measurement scripts for the port."""
