"""Model side of the port: the Transformer LM, training, generation,
serving."""
