"""The plain reference of the served program: float32 forwards of the two
networks, the maps' upsampling and smoothing, the frozen grouping oracle,
and the letterbox. It imports nothing of the program."""
