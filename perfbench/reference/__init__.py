"""The plain reference: the served and trained models written out in
plain PyTorch, computed in float32 (TF32 off), layer by layer so that it
fits beside nothing else on the card. It imports nothing of the program
and takes nothing the program made: it draws the benchmark's weights
again from the seed (``perfbench.harness.weights``) and reads the
program's outputs only to judge them."""
