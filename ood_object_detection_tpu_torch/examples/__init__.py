"""Runnable examples of the port (``python -m
ood_object_detection_tpu_torch.examples.<name>``)."""
