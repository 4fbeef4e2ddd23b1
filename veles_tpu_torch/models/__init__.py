"""Forward layer families (all2all, conv, pooling, dropout) and the
model zoo; counterpart of ``veles_tpu/models``."""
