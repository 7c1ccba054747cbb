"""The LM model zoo of the port: layers, SSD, the model and its serving
steps, and the converter from the JAX package's parameter trees."""
