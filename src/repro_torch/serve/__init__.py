"""CNN serving on the card: counterpart of ``repro.serve``'s CNN layer.

  * :mod:`.shape_ladder` folds request shapes onto configured rungs;
  * :mod:`.cnn_batching` buckets and batches requests, with the reference's
    scheduler over steps replayed as CUDA graphs from pinned staging;
  * :mod:`.faults` injects seeded faults at the dispatch boundary;
  * :mod:`.trace` records, compares and replays event streams;
  * :mod:`.fleet` is the control plane over named stacks: noise canary,
    background deploy-QAT retrain and hot-swap, each decision traced.

The LM batcher and decode loop wait for the integer LM.
"""
