"""Serving: the continuous-batching LM engine (`engine`) and the
multi-tenant STREAK serving loop (`spatial`)."""
