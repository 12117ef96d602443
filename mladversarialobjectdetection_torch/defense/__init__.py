"""Patch-attack defender: masker, training core and driver."""
