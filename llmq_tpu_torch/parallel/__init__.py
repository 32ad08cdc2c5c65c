"""Intra-replica parallelism: the rank mesh, the partition rules and
multi-process bring-up (counterpart of ``llmq_tpu/parallel``).

JAX's replica is one controller whose programs GSPMD partitions over a
device mesh. The port's is one process per rank over
``torch.distributed``: rank 0 runs the serving process and drives, the
other ranks follow its executor (``engine/executor.py``), each holding
its ``tp`` shard of the weights and of the paged pool
(:func:`shard_params`, :func:`kv_cache_shardings`) and launching the
port's kernels on it; the model's collectives stitch the shards
(``models/llama.py``). A ``dp`` axis splits the batch and the pool's
page axis into replicas, each with its page universe and guest pages
(:class:`~llmq_tpu_torch.parallel.dp.DpPlane`).
"""

from llmq_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    distributed_init,
    make_mesh,
    single_device_mesh,
)
from llmq_tpu_torch.parallel.sharding import (  # noqa: F401
    LLAMA_PARTITION_RULES,
    P,
    abstract_params,
    batch_sharding,
    describe,
    kv_cache_shardings,
    match_partition_rules,
    param_shardings,
    replicated,
    resolve_rules,
    shard_params,
    tensor_parallel,
)
