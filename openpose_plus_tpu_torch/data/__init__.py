"""The data the port reads: COCO keypoint annotations and their loss masks,
the train-time augmentation and the eval-time letterbox, the host training
pipeline and image loader, ground-truth map synthesis on the device, and
the seeded synthetic scene bank (copies of `openpose_plus_tpu/data/*`)."""
