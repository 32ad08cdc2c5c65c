"""The endpoint load balancer (``load_balancer.py``), the circuit breaker
(``circuit_breaker.py``), the HTTP transport to peer serve processes
(``transport.py``) and the message router over them (``router.py``)."""
