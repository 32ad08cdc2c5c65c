"""The port's binding of the native queue core (``native/src/mlq.cpp``)."""
