"""The port's compile layer (vendored numpy host modules), RNG, engine and fleet."""
