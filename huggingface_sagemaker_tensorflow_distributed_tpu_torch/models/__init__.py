"""Models of the PyTorch port (GPT-2 for serving and causal-LM training,
BERT for sequence classification)."""
