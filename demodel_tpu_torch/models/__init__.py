"""Model families of the port: Llama, its weight converters and loader."""
