"""Training of the port: AdamW on float32 masters, with ZeRO-1 state on a
``DeviceMesh`` (``optimizer``), and the train step with microbatched
gradient accumulation, remat and bf16 gradient compression
(``train_step``, on one device)."""
