"""The general machinery of a benchmark run: the manifest, the traffic
generator, the measured window, the trace reduction and the guards."""
