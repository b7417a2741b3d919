"""Models of the port: the dense decoder-only LM (`transformer`) and its
building blocks (`layers`)."""
