"""One module a model kind, found by the configuration's ``kind``
(``spec.kind(name)`` loads ``kinds/<name>.py``).  A kind gives all that
the harness needs to know of a model and nothing else branches on it:

* ``PORT_KIND``: the kind string that the system's ``build_model``,
  ``build_fold`` and ``resident_store`` take;
* ``model_config(cfg)``: the system's ``ModelConfig`` for the
  configuration file ``cfg``;
* ``param_specs(cfg)``: every parameter and buffer of the model in the
  system's naming, with its shape and how it is drawn
  (``portbench/weights.py``);
* ``memes(cfg, traffic, n, rng, g, device)``: the model's inputs of ``n``
  memes but the label, from the one generator's pieces
  (``portbench/data.py``), drawing from ``rng`` and ``g`` in a fixed order;
* ``logits(W, cfg, batch, training, P)``: the plain reference's logits
  (``portbench/reference/``);
* ``forward_flops(cfg, n, tokens)`` and ``attention_parts(cfg, n,
  tokens)``: the model FLOPs of ``n`` memes' forward pass and each
  attention stack with its sequences' lengths (``portbench/counts/``),
  from each meme's own token counts (``tokens``: ``{"text": [n],
  "caption": [n]}``, the branches the memes have);
* ``PACKED``: the module prefix of each encoder whose dropout masks come
  over packed rows, with the batch's prefix of those rows (``t_``, ``c_``).

Nothing here imports the system when a module is loaded: the port's
configuration classes are imported inside ``model_config``."""
