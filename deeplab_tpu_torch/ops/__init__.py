"""Layer ops of the port: padding, conv, eval BN, TF1 resize, initializers."""
