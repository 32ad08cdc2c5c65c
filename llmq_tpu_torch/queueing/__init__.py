"""Queue plane of the port: priority queues, manager, workers with retry
backoff, the delayed and dead-letter queues, and the factory that wires
them."""
