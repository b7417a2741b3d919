"""Distributed-training pieces that run on one device: int8 gradient
compression with error feedback (`grad_compression`)."""
