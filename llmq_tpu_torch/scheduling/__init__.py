"""The card's topology, the resource scheduler over it and the endpoint
autoscaler (the port's copy of ``llmq_tpu/scheduling/``)."""
