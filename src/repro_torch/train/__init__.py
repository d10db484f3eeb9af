"""Step builders of the LM scaffold (the port of ``repro.train``); only the
serve step so far (``train_step.make_serve_step``)."""
