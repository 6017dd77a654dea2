"""Experiment CLIs of the port (``python -m sspslam_tpu_torch.experiments.<name>``)."""
