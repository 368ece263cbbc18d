"""FST training of the port on one device: the losses, schedules and
optimizers, the step, the phase-1 and phase-2 objectives, and the trainers
(``train.trainer.train_phase1`` / ``train_phase2``). Importing the package
imports neither PIL nor cv2."""
