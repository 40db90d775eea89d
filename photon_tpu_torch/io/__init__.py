"""Avro and LIBSVM input, the reference schemas, model files."""
