"""PS1-authentic audio: tracker song model + SPU reverb/resampler DSP
(the port of the JAX package's `audio/`: host song IO and synthesis, the
SPU recurrences as CUDA kernels)."""
