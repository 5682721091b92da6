"""Served model families: everything of a served model that the serve kind
(``kinds/serve.py``) does not share with other models. A configuration
names its family in its ``family`` key (without one: ``pairnet``); the
registry loads ``portbench/families/<family>.py`` from the checkout, so a
family is added with a file alone. A family module gives:

* ``weights(model_cfg, seed, device, dtype)``: the benchmark's seeded
  tensors by name;
* ``build(model_cfg, weights, device, dtype, msda)``: the port's model
  holding them, in eval mode, every MSDA on ``msda``;
* ``BOUNDARIES``: (part, module name) pairs whose forward hooks end each
  stage span of the traced run, in order;
* ``Taps(model)``: hooks kept on for one checked request; ``close()``
  removes them, ``keep(out)`` gives what the check reads of the request
  (the serve kind adds ``got``, the predictions on the host);
* ``reference_check(cell, seed, dev, kept, pool)``: (value, limit) of each
  number over the kept requests, the limits from the configuration;
* ``shape_counts(model_cfg, image_hw, batch)``: ``flops_per_image`` and the
  counts from shapes that the per-layer readers take (``msda_least_s``,
  ``msda_calls_per_unit``);
* ``stand_in(cell, seed, dev, images, rnd)``: the kept requests of the plain
  reference in the system's place, its products rounded by ``rnd`` (the
  control, ``portbench/control.py``).
"""
