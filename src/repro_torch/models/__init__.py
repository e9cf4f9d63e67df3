"""Model stack of the port: the decoder (`transformer`), its layers, the
Mamba2 SSD mixer (`ssm`) and the mixture-of-experts block (`moe`)."""
