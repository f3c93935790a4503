"""Model graphs of the port (AR decoder, denoiser, vocoder)."""
