"""Operator tools of the port."""
