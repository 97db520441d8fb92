"""The frozen yardstick: the card's peaks, and the bytes, operations and
model FLOPs of each kernel and family, all worked out from the model's
shapes and never from the shapes a kernel happens to receive. No count
depends on how a kernel cuts its work."""
