"""Shared pipeline constants (port of mc_slam_tpu/pipeline/pipebase.py): the
tracking state machine of the reference, include/Tracking.h:113-120."""
NO_IMAGES_YET, NOT_INITIALIZED, OK, LOST = range(4)
