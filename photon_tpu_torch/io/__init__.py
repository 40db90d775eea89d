"""Avro and LIBSVM input, the reference schemas, model and score files."""
