"""Synthetic RDF datasets and their benchmark queries."""
