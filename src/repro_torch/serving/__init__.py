from repro_torch.serving.decode import SlotServer, make_serve_step, serve_step
