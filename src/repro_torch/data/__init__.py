"""Synthetic datasets: RDF graphs and their benchmark queries, GTFS ingest,
the query fuzzer and the LM token stream."""
