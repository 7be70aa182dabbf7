"""k2 flavor (reazonspeech-k2-v2, Zipformer transducer) of the port."""
