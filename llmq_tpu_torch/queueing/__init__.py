"""Queue plane of the port: priority queues, manager and workers."""
