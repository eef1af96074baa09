"""Training: Charbonnier loss, two-group Adam, cosine-restart schedule."""
