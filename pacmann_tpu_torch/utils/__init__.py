"""u32 helpers, stable top-k and the CUDA build loader."""
