"""Microsoft Edge neural voice catalog (35 languages x 2 voices): a copy of
the JAX package's app/tts_voices.py.

The catalog the upstream UI offers; display names in English.
"""

EDGE_VOICES = {
    "English (UK)": ["en-GB-SoniaNeural", "en-GB-RyanNeural"],
    "English (US)": ["en-US-JennyNeural", "en-US-GuyNeural"],
    "Arabic (Egypt)": ["ar-EG-SalmaNeural", "ar-EG-ShakirNeural"],
    "Arabic (Saudi Arabia)": ["ar-SA-HamedNeural", "ar-SA-ZariyahNeural"],
    "Bengali (Bangladesh)": ["bn-BD-RubaiyatNeural", "bn-BD-KajalNeural"],
    "Hungarian": ["hu-HU-TamasNeural", "hu-HU-NoemiNeural"],
    "Vietnamese": ["vi-VN-HoaiMyNeural", "vi-VN-HuongNeural"],
    "Greek": ["el-GR-AthinaNeural", "el-GR-NestorasNeural"],
    "Danish": ["da-DK-PernilleNeural", "da-DK-MadsNeural"],
    "Hebrew": ["he-IL-AvriNeural", "he-IL-HilaNeural"],
    "Spanish (Spain)": ["es-ES-ElviraNeural", "es-ES-AlvaroNeural"],
    "Spanish (Mexico)": ["es-MX-DaliaNeural", "es-MX-JorgeNeural"],
    "Italian": ["it-IT-ElsaNeural", "it-IT-DiegoNeural"],
    "Chinese (Simplified)": ["zh-CN-XiaoxiaoNeural", "zh-CN-YunxiNeural"],
    "Korean": ["ko-KR-SunHiNeural", "ko-KR-InJoonNeural"],
    "German": ["de-DE-KatjaNeural", "de-DE-ConradNeural"],
    "Dutch": ["nl-NL-ColetteNeural", "nl-NL-FennaNeural"],
    "Norwegian": ["nb-NO-PernilleNeural", "nb-NO-FinnNeural"],
    "Polish": ["pl-PL-MajaNeural", "pl-PL-JacekNeural"],
    "Portuguese (Brazil)": ["pt-BR-FranciscaNeural", "pt-BR-AntonioNeural"],
    "Portuguese (Portugal)": ["pt-PT-RaquelNeural", "pt-PT-DuarteNeural"],
    "Romanian": ["ro-RO-EmilNeural", "ro-RO-AndreiNeural"],
    "Russian": ["ru-RU-SvetlanaNeural", "ru-RU-DmitryNeural"],
    "Tagalog": ["tl-PH-AngeloNeural", "tl-PH-TessaNeural"],
    "Tamil": ["ta-IN-ValluvarNeural", "ta-IN-KannanNeural"],
    "Thai": ["th-TH-PremwadeeNeural", "th-TH-NiwatNeural"],
    "Turkish": ["tr-TR-AhmetNeural", "tr-TR-EmelNeural"],
    "Ukrainian": ["uk-UA-OstapNeural", "uk-UA-PolinaNeural"],
    "Filipino": ["fil-PH-AngeloNeural", "fil-PH-TessaNeural"],
    "Finnish": ["fi-FI-NooraNeural", "fi-FI-SelmaNeural"],
    "French (Canada)": ["fr-CA-SylvieNeural", "fr-CA-AntoineNeural"],
    "French (France)": ["fr-FR-DeniseNeural", "fr-FR-HenriNeural"],
    "Czech": ["cs-CZ-VlastaNeural", "cs-CZ-AntoninNeural"],
    "Swedish": ["sv-SE-HilleviNeural", "sv-SE-MattiasNeural"],
    "Japanese": ["ja-JP-NanamiNeural", "ja-JP-KeitaNeural"],
}

ALL_VOICES = sorted(v for pair in EDGE_VOICES.values() for v in pair)
