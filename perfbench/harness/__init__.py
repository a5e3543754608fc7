"""The benchmark harness of ``pygradflow_torch``: manifest, traffic
generator, the measured window, trace reduction, roofline yardstick and the
comparison that decides ``correct``."""
