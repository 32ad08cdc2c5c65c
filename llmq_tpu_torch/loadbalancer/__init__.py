"""The endpoint load balancer (``load_balancer.py``) and the circuit
breaker (``circuit_breaker.py``)."""
