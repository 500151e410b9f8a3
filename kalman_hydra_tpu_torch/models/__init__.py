"""Track models of the port: dynamics, Kalman filter, lifecycle."""
