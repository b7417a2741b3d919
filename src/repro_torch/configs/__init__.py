"""Published model configurations the port runs (`registry`)."""
