"""One file per decoder that a configuration's ``run_config["decoder"]``
names, ``<decoder>.py``, found by that name (``spec.reference_decoder``).
A cell whose decoder has no file here is refused when it is loaded. Each
file holds:

- ``decoder(run_config, tables, precision=None)``: the plain reference
  decoder, llr -> (x_hat, iters); ``precision`` replaces the precision the
  configuration states (the control);
- ``control_precision(run_config)``: the control's precision, the nearest
  one below the configuration's, with the reason for the choice;
- ``TRACK_ITER_HIST``: whether the program's decoder keeps the 2000-bin
  iteration histogram, so that the replay tallies it and the check
  compares it (``hist_diff``).

A file imports the plain decoders of ``reference/`` and nothing of the
program or of JAX."""
