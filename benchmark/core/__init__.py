"""The benchmark's yardstick: manifest and file lookup, traffic, weights,
traces, peaks. Nothing here imports the JAX package."""
