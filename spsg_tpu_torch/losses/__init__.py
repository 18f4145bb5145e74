"""Training losses (PyTorch counterparts of ``spsg_tpu/losses``)."""
