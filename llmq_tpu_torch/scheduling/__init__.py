"""The card's topology and the resource scheduler over it (the port's
copy of ``llmq_tpu/scheduling/``, without the endpoint autoscaler)."""
