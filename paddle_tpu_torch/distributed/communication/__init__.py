"""Process groups and collectives (counterpart of
``paddle_tpu/distributed/communication/``)."""
