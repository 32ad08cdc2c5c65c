"""The endpoint load balancer (``load_balancer.py``)."""
