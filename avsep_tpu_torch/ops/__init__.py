"""Signal ops: STFT / iSTFT and their CUDA kernels, log-frequency warp,
mixture preparation."""
