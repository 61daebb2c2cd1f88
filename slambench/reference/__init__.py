"""Plain references the benchmark holds the program against: the scene
renderer (ground truth), the ORB front-end and the trajectory alignment.

Plain PyTorch and NumPy only: nothing here imports the program, so a fault
in the program cannot hide in its own reference.
"""
