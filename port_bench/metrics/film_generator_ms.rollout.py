"""film_generator_ms.rollout: device time of the FiLM generator's forward
(events on the compute stream around the program's `film_gen` module) per
member-step."""


def read(rec):
    if "film_gen_s" not in rec or not rec["units_traced"]:
        return None
    return rec["film_gen_s"] / rec["units_traced"] * 1e3
