"""Model side of the port: the Transformer LM, generation, serving."""
