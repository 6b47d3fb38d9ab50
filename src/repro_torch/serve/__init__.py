"""Serving on the card: counterpart of ``repro.serve`` (CNNs and the integer LM).

  * :mod:`.shape_ladder` folds request shapes onto configured rungs;
  * :mod:`.cnn_batching` buckets and batches requests, with the reference's
    scheduler over steps replayed as CUDA graphs from pinned staging;
  * :mod:`.faults` injects seeded faults at the dispatch boundary;
  * :mod:`.trace` records, compares and replays event streams;
  * :mod:`.fleet` is the control plane over named stacks: noise canary,
    background deploy-QAT retrain and hot-swap, each decision traced;
  * :mod:`.batching` is the integer LM's continuous batcher over fixed
    decode slots, and :mod:`.decode` its sampling (greedy, temperature,
    top-k), the reference's Gumbel draws bit for bit.
"""
