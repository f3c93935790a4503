"""Stage drivers of the port: AR -> diffusion -> vocoder -> WAV."""
