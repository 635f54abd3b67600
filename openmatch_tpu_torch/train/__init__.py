"""Training: the optimizer and checkpoints (``state``) and the dense
retrieval trainer (``dr_trainer``). Import the modules themselves; this
package imports nothing."""
