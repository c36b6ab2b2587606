"""Developer tools of the port (the JAX package's sphexa_tpu/devtools): the
audit package's entry registry and its static roofline cost layer."""
