"""The port's example drivers, each runnable as
``python -m repro_torch.examples.<name>`` (``--device cpu`` for the CPU;
the card otherwise): ``quickstart``, ``train_cosmoflow``,
``train_unet3d``, ``serve_volumes`` and ``serve_lm`` (a small language
model trained briefly, then served). Each module's ``main(argv)``
takes the command line's arguments as a list."""
