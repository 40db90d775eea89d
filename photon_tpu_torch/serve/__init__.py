"""Serving (port of photon_tpu/serve): so far the consistent-hash ring that the
entity-sharded training path shares with serving."""
