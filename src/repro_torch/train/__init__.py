"""Training-side modules of the port: the train, eval and serving steps
(``train_step``), the non-finite step guard (``guard``) and the
checkpoint reader and writer (``checkpoint``)."""
