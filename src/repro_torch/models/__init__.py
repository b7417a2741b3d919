"""Models of the port: the dense decoder-only LM (`transformer`), the
mixture-of-experts LM (`moe`) and their building blocks (`layers`)."""
