"""Architecture configs (shapes only), copied from the JAX package so that
the port imports nothing of it.  ``registry.get_arch(name)`` resolves an
``--arch`` id."""
