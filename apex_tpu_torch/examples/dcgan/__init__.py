"""The DCGAN example (counterpart of ``examples/dcgan``): ``main_amp``
trains a generator and a discriminator under amp with three separately
scaled losses."""
