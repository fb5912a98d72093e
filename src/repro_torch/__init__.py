"""PyTorch + CUDA port of the LUT-DNN toolflow (QAT training, truth-table
synthesis, artifacts, the LUT engine and its serving stack) and the
language models of the registry (attention, MoE, RG-LRU and RWKV6
decoders, and the whisper encoder-decoder).

A second package beside ``repro`` (the JAX reference), laid out in the
same way: ``repro_torch.<module>`` is the counterpart of
``repro.<module>``.  It imports torch and numpy only — never JAX and
nothing of the ``repro`` package; what it needs from framework-free
``repro`` modules it keeps as its own copy.

Entry points (``core.lutdnn.init_model`` / ``make_train_step``,
``data.batch_iterator``, ``artifact.load_artifact``, ``core.lut_synth.
tables_from_numpy``, ``kernels.lut_gather.ops.make_network_fn``,
``launch.registry.ModelRegistry``, ``launch.serve.init_lm`` /
``serve_lm`` / ``serve_lut``) run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no such argument they raise (see
``repro_torch.device``).
"""
