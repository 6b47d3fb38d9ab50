"""CNN serving on the card: counterpart of ``repro.serve``'s CNN layer.

  * :mod:`.shape_ladder` folds request shapes onto configured rungs;
  * :mod:`.cnn_batching` buckets and batches requests, with the reference's
    scheduler over steps replayed as CUDA graphs from pinned staging;
  * :mod:`.faults` injects seeded faults at the dispatch boundary;
  * :mod:`.trace` records and compares the batcher's event streams.

The fleet control plane (``serve/fleet.py``) and trace replay wait for the
training slice (the fleet retrains); the LM batcher and decode loop wait
for the integer LM.
"""
