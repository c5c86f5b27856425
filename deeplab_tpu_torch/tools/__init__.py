"""Tools over the port (the JAX repo's ``tools/``): the trace reader and the
region tables of the train step, the Xception serving forward and the CRF,
and the example gallery."""
