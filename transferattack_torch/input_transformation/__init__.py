"""Input-transformation attacks (counterpart of
``transferattack_tpu/input_transformation/``)."""
