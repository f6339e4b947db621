"""Training-side modules of the port. So far only the checkpoint reader
(``checkpoint``), which serving needs; the train step, the optimizer and
the checkpoint writer come with the training slice."""
