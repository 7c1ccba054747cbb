"""The LM model zoo of the port: layers, SSD, the model, its train and
serving steps, and the converter from (and back to) the JAX package's
parameter and optimizer trees."""
