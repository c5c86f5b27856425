"""Examples over the port (the JAX repo's ``examples/``): the reference
notebook's workflow as a script."""
