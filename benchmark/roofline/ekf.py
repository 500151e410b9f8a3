"""The Kalman step of the whole track pool: each track's state and
covariance read and written once and its flow sample's four corners
read; operations 4 n^3 for the covariance's prediction, 4 n^3 for the
Joseph-form update and 40 n for the rest (gain, residual, NIS)."""


def work(run_cfg: dict, frame: dict, counts: dict):
    n = run_cfg["ekf"]["state_dim"]
    k = run_cfg["tracks"]["num_tracks"] * counts["track_steps"]
    return k * ((n + n * n) * 4 * 2 + 32), k * (8 * n ** 3 + 40 * n)
