"""The data the port's evaluation reads: COCO keypoint annotations, the
letterbox transform and image loader, ground-truth map synthesis, and the
seeded synthetic scene bank (copies of `openpose_plus_tpu/data/*`; the
training pipeline and its augmentation are ROADMAP.md item 'Training')."""
