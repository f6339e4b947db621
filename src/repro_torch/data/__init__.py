"""The input pipeline (the reference's ``data/``): synthetic datasets,
the hyperslab store, the spatially parallel loader and its prefetching
wrapper."""
