"""The reference's example scripts (`examples/*.py`) on the port.

Each module runs as ``python -m repro_torch.examples.<name>`` from the
repository root with ``PYTHONPATH=src``, takes the reference script's
flags and defaults plus ``--device`` (CUDA unless ``--device cpu`` is
given; without a GPU and without ``--device`` it raises, as every port
launcher does), prints what the reference prints and keeps its
assertion.  Its body is ``main(argv=None)``, which returns what it
measured, so tests and ``chip_smoke.py`` can run it in-process.

* `quickstart` — Block 1 and Block 2: MADQN through the Python
  environment loop, then fused (anakin) with greedy evals, then IPPO;
* `distributed_ippo` — IPPO on spread under anakin, then four sharded
  executors on `torch.distributed`;
* `smax_vdn` — VDN against independent MADQN on smax-lite (Fig. 4,
  bottom);
* `switch_game_dial` — DIAL against no communication on the switch
  riddle (Fig. 4, top);
* `continuous_batching` — the LM serving engine over eight ragged
  requests, one of them held against sequential generation;
* `lm_train` — a 4-layer, 512-wide internlm2-family model trained on the
  synthetic bigram corpus until its loss drops.

The learning assertions (quickstart, lm_train) hold at the reference's
sizes: they are made when every size flag has its default, and a run cut
smaller says that it does not make them.
"""


def at_reference_sizes(args, parse_args, flags) -> bool:
    """Whether each of ``flags`` in ``args`` has its default, the reference's size."""
    defaults = parse_args([])
    return all(getattr(args, f) == getattr(defaults, f) for f in flags)
