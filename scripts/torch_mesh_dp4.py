"""chip_smoke's serve-mesh c over dp=2 x tp=2 on four cards: an NCCL
world, one card a rank, rank 0 the ``App`` and ranks 1-3
``python -m llmq_tpu_torch serve`` followers. A check of the dp plane
over NCCL tp groups, not a phase of chip_smoke (which needs one card).

    python3 scripts/torch_mesh_dp4.py [OUT_DIR]

on a machine with four cards, from the repository's root. Sockets stay
on the loopback device (NCCL and gloo); every process dumps its Python
stacks every 180 s, so a hang shows where it waits; the logs, status
files and the driver's record go to OUT_DIR (default
``llmq_tpu_torch/_build/mesh_dp4``). Prints serve-mesh c's report lines
and exits non-zero on a failed gate."""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
os.environ.update(NCCL_SOCKET_IFNAME="lo", GLOO_SOCKET_IFNAME="lo",
                  NCCL_DEBUG="WARN")

import chip_smoke as cs  # noqa: E402
from llmq_tpu_torch.ops import kernels  # noqa: E402

STACKS = ("import faulthandler; "
          "faulthandler.dump_traceback_later(180, repeat=True)\n")


def main() -> int:
    cs.SPLIT_PRELUDE = STACKS + cs.SPLIT_PRELUDE
    cs.MESH_DP_DRIVER = STACKS + cs.MESH_DP_DRIVER
    cs.MESH_C_S = 240.0
    cs.CARD = cs.nvidia_smi_line()
    os.system("nvidia-smi --query-gpu=name,power.limit "
              "--format=csv,noheader")
    t0 = time.time()
    kernels.build()
    cs.log(f"built in {time.time() - t0:.1f} s")
    work = (sys.argv[1] if len(sys.argv) > 1 else
            os.path.join(os.getcwd(), "llmq_tpu_torch", "_build", "mesh_dp4"))
    os.makedirs(work, exist_ok=True)
    t0 = time.time()
    res = cs._mesh_dp(work, {"dp": 2, "tp": 2})
    cs.log(f"c. over dp2 x tp2 took {time.time() - t0:.1f} s")
    with open(os.path.join(work, "res.json"), "w") as f:
        json.dump(res, f, default=str)
    cs._mesh_dp_gates(res)
    print("dp2 x tp2: every gate held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
